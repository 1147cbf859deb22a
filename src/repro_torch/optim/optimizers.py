"""AdamW and Adafactor on trees (nested dicts) of tensors (the counterpart of
``repro.optim.optimizers``).

State trees mirror the parameter tree.  Unlike the JAX package, which returns
new arrays, ``update`` writes the new parameters and state IN PLACE and
returns the same trees: a full-width model's fp32 moments are 8 B a
parameter, and a second copy of them is what the in-place update saves.
Updates run per tensor under ``torch.no_grad``, in fp32, and round once to
the parameter's dtype, a large leaf in slices (``CHUNK``) so that the
update's fp32 temporaries stay small.  ``count`` is a 0-d int32 tensor on
the parameters' device, so the schedules, bias corrections and the whole
step need no host sync.

Under ZeRO (``train/step.py``'s sharded step) ``update`` gets each rank's
shard of every parameter and gradient, with ``shards`` saying where each
lies.  AdamW is elementwise and ignores it.  Adafactor's moments are means
over the whole parameter, so it sums its rows and columns across the
shards (see :func:`adafactor`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from ..distributed.collectives import (all_reduce, axes_of, gather_full,
                                       local_shard)


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    # (grads, state, params, step=None, norm=None, shards=None)
    #   -> (params, state, gnorm)
    update: Callable[..., tuple]
    name: str = "opt"


@dataclass(frozen=True)
class Shards:
    """Where the leaves of a sharded update lie: parameter i's shard (and
    its gradient's) is its part under ``specs[i]`` on ``mesh`` of a tensor
    of ``shapes[i]``."""
    mesh: Any
    specs: list
    shapes: list


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


# Elements a leaf's update handles at once.  A stacked leaf of a full-width
# model is large (granite-moe-3b-a800m's 32 x 48 experts' gate weights are
# 1.2 B elements, 4.8 GB in fp32), and each fp32 temporary of a whole-leaf
# update would be as large; slices of 2^26 bound them at 256 MB.  Leaves
# below it are one slice, and every element's arithmetic is the same.
CHUNK = 1 << 26


def _slices(*ts):
    """Matching flat slices of ``ts`` (tensors of one shape), at most
    ``CHUNK`` elements each; one slice of the whole tensors where they are
    small or not all contiguous.  Writes to a slice land in its tensor."""
    n = ts[0].numel()
    if n <= CHUNK or not all(t.is_contiguous() for t in ts):
        yield ts
        return
    flat = [t.view(-1) for t in ts]
    for i in range(0, n, CHUNK):
        yield tuple(f[i:i + CHUNK] for f in flat)


def _global_norm(leaves) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(c.float()))
                          for g in leaves for (c,) in _slices(g)))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float, norm=None):
    """Scale ``grads`` (in place) to a global norm of at most ``max_norm``;
    returns (grads, the norm before clipping).  ``norm``: the global norm
    when ``grads`` are one rank's shards of it (the sharded train step
    computes it across the ranks)."""
    leaves = tree_leaves(grads)
    if norm is None:
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
    def update(grads, state, params, step=None, norm=None, shards=None):
        grads, gnorm = clip_by_global_norm(grads, grad_clip, norm)
        state["count"].add_(1)
        count = state["count"]
        lr_t = _lr(lr, count)
        cf = count.float()
        bc1 = 1 - b1 ** cf
        bc2 = 1 - b2 ** cf
        for leaf in zip(tree_leaves(params), tree_leaves(grads),
                        tree_leaves(state["m"]), tree_leaves(state["v"])):
            for p, g, m, v in _slices(*leaf):
                gf = g.float()
                m.mul_(b1).add_(gf, alpha=1 - b1)
                v.mul_(b2).addcmul_(gf, gf, value=1 - b2)
                pf = p.float()
                upd = (m / bc1) / (torch.sqrt(v / bc2) + eps) \
                    + weight_decay * pf
                p.copy_(pf - lr_t * upd)
        return params, state, gnorm

    return Optimizer(init=init, update=update, name="adamw")


# ---------------------------------------------------------------------------
# Adafactor (factored second moment, no first moment)
# ---------------------------------------------------------------------------

def _mean_whole(x, dim: int, spec, shape, mesh):
    """The mean of the whole tensor (of ``shape``, of which ``x`` is the
    shard under ``spec``) over ``dim``, whole: the shard's partial sums
    summed over the axes that split ``dim``, then gathered over the axes
    that split the other dims.  Without a mesh, ``x.mean(dim)``."""
    if mesh is None:
        return x.mean(dim=dim)
    dim %= x.dim()
    if mesh.axes_size(spec[dim]) == 1:
        part = x.mean(dim=dim)
    else:
        part = all_reduce(x.sum(dim=dim), spec[dim], mesh) / shape[dim]
    rest = [e for d, e in enumerate(spec) if d != dim]
    return gather_full(part, rest, mesh,
                       [n for d, n in enumerate(shape) if d != dim])


def _rms_whole(u, spec, shape, mesh):
    """sqrt(mean(u²) + 1e-30) over the whole tensor whose shard is ``u``."""
    if mesh is None:
        return torch.sqrt(torch.mean(u * u) + 1e-30)
    axes = {a for e in spec for a in axes_of(e)}
    axes = tuple(a for a in mesh.axis_names if a in axes)
    total = all_reduce(torch.sum(u * u), axes, mesh)
    n = 1
    for d in shape:
        n *= d
    return torch.sqrt(total / n + 1e-30)


def adafactor(lr: float | Callable = 1e-3, decay: float = 0.8,
              eps: float = 1e-30, clip_threshold: float = 1.0,
              weight_decay: float = 0.0, grad_clip: float = 1.0) -> Optimizer:
    """Adafactor.  Under ``shards`` its state is whole on every rank (the
    specs ``param_pspecs`` gives it replicate every moment) while each
    rank holds a shard of each parameter and gradient: vr (the mean of g²
    over the last axis), vc (over the second to last) and vr's mean are
    means over the whole parameter, summed across the shards of the
    reduced dim and gathered across the others; the update clip's RMS is
    summed across every axis that splits the parameter; the unfactored v
    gathers g² only where its parameter is split.  Each rank then updates
    its shard of the parameter."""

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
    def update(grads, state, params, step=None, norm=None, shards=None):
        grads, gnorm = clip_by_global_norm(grads, grad_clip, norm)
        state["count"].add_(1)
        count = state["count"]
        lr_t = _lr(lr, count)
        beta = 1.0 - count.float() ** -decay
        slots = _slot_leaves(state["s"])
        leaves = tree_leaves(params)
        mesh = shards.mesh if shards is not None else None
        for i, (p, g, s) in enumerate(zip(leaves, tree_leaves(grads), slots)):
            spec = shards.specs[i] if mesh is not None else None
            shape = shards.shapes[i] if mesh is not None else p.shape
            gf = g.float()
            g2 = gf * gf + eps
            if _factored(shape):
                row = _mean_whole(g2, -1, spec, shape, mesh)
                col = _mean_whole(g2, -2, spec, shape, mesh)
                s["vr"].copy_(beta * s["vr"] + (1 - beta) * row)
                s["vc"].copy_(beta * s["vc"] + (1 - beta) * col)
                vr, vc = s["vr"], s["vc"]
                r = vr / torch.clamp(vr.mean(dim=-1, keepdim=True), min=eps)
                if mesh is not None:        # this shard's rows and columns
                    r = local_shard(r, spec[:-1], mesh)
                    vc = local_shard(vc, tuple(spec[:-2]) + tuple(spec[-1:]),
                                     mesh)
                denom = r[..., None] * vc[..., None, :]
                u = gf * torch.rsqrt(torch.clamp(denom, min=eps))
            else:
                v = s["v"]
                if mesh is not None:
                    g2 = gather_full(g2, spec, mesh, shape)
                v.copy_(beta * v + (1 - beta) * g2)
                if mesh is not None:
                    v = local_shard(v, spec, mesh)
                u = gf * torch.rsqrt(torch.clamp(v, min=eps))
            # update clipping (RMS <= clip_threshold)
            rms = _rms_whole(u, spec, shape, mesh)
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


__all__ = ["Optimizer", "Shards", "adamw", "adafactor", "pick_optimizer",
           "clip_by_global_norm", "tree_leaves", "tree_map"]
