"""Vocab-parallel cross-entropy (the counterpart of
``repro.distributed.vocab_ce``).

With the unembedding sharded over ``model`` on its vocab dim, each rank
computes the logits of its vocab slice and the ranks exchange per-token
scalars (a max, then the sum of exp and the label logit), never the
(T, V) logits.  The local statistics are plain torch, as the reference's
are plain jnp (``_local_ce_stats``): this is not the CE kernel's path.

Gradients: x enters the vocab-split region through ``enter_split`` (its
gradient is the sum of the ranks' partial ones), the sums leave it through
``leave_split`` (each rank gets the replicated gradient), and the max is a
stabiliser that gets none (the reference's ``stop_gradient``).
"""

from __future__ import annotations

import torch

from .collectives import all_reduce, enter_split, leave_split, shard_bounds
from .context import current_context


def vocab_parallel_ce(x, w, labels, valid, n_valid: int, axis: str = "model",
                      vocab_size: int | None = None):
    """x: (T, D), replicated over ``axis``; w: (D, V/tp), this rank's vocab
    slice of the unembedding (``vocab_size`` is the full V: give it when
    the slices are uneven); labels / valid: (T,).  Returns the mean NLL over
    the valid tokens.  With no context, or no ``axis`` in its mesh, it is
    the fused CE kernel on the whole ``w``."""
    ctx = current_context()
    if ctx is None or axis not in ctx.mesh.shape:
        from ..kernels import fused_cross_entropy
        return fused_cross_entropy(x, w, labels, valid=valid,
                                   n_valid=n_valid)
    mesh = ctx.mesh
    idx = mesh.index(axis)
    v_lo = (idx * w.shape[1] if vocab_size is None else
            shard_bounds(vocab_size, mesh.axes_size(axis), idx)[0])
    xf = enter_split(x.float(), axis, mesh)
    v_loc = w.shape[1]
    # (T, V/tp) fp32, masked in place (the product's backward needs none of
    # its output): two buffers of that size, this and its exp, are the
    # forward's peak
    logits = xf @ w.float()
    if v_lo + v_loc > n_valid:
        cols = v_lo + torch.arange(v_loc, device=x.device)
        logits = logits.masked_fill_(cols[None, :] >= n_valid, float("-inf"))
    # the stabiliser: lse is analytically invariant to it
    m = logits.detach().amax(dim=1).clamp_min(-1e30)
    m_glob = all_reduce(m, axis, mesh, op="max")
    lab = labels.long() - v_lo
    mine = (lab >= 0) & (lab < v_loc)
    ll = logits.gather(1, lab.clamp(0, max(v_loc - 1, 0))[:, None])[:, 0]
    ll = torch.where(mine, ll, torch.zeros_like(ll))
    sumexp = torch.exp(logits - m_glob[:, None]).sum(dim=1)
    # one rank holds each label column, so the sum of ll is exact
    sumexp_glob, ll_glob = leave_split(torch.stack([sumexp, ll]), axis, mesh)
    lse = m_glob + torch.log(sumexp_glob.clamp_min(1e-30))
    vf = valid.float()
    return ((lse - ll_glob) * vf).sum() / vf.sum().clamp_min(1.0)
