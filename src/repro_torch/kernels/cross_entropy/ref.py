"""Plain PyTorch LM-head cross-entropy (the counterpart of
``repro.kernels.cross_entropy.ref`` and of the chunked jnp forward and
backward in ``repro.kernels.cross_entropy.ops``)."""

from __future__ import annotations

import torch

CHUNK_V = 8192          # the JAX package's _CHUNK_V


def cross_entropy_ref(x, w, labels, valid=None):
    """x: (T, D) final hidden states; w: (D, V) unembedding; labels: (T,).
    valid: optional (T,) bool mask.  Returns the mean NLL over valid tokens.
    Builds the whole (T, V) fp32 logits: the oracle, not the path."""
    logits = x.float() @ w.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(1, labels.long()[:, None])[:, 0]
    nll = lse - ll
    if valid is None:
        return nll.mean()
    vf = valid.float()
    return (nll * vf).sum() / vf.sum().clamp_min(1.0)


def _chunks(V: int):
    for c0 in range(0, V, CHUNK_V):
        yield c0, min(V, c0 + CHUNK_V)


def ce_forward_chunked(x, w, labels, n_valid: int):
    """(lse, label_logit), each (T,) fp32, by 8192-column chunks of w with an
    online logsumexp; columns at or past ``n_valid`` are excluded.  The
    counterpart of JAX's ``_forward_chunked``, and the plain version the
    CUDA kernel is held against."""
    T = x.shape[0]
    xf = x.float()
    m = torch.full((T,), float("-inf"), device=x.device)
    l = torch.zeros((T,), device=x.device)
    ll = torch.full((T,), float("-inf"), device=x.device)
    lab = labels.long()[:, None]
    for c0, c1 in _chunks(w.shape[1]):
        logits = xf @ w[:, c0:c1].float()                 # (T, cv)
        cols = torch.arange(c0, c1, device=x.device)[None, :]
        logits = logits.masked_fill(cols >= n_valid, float("-inf"))
        m_new = torch.maximum(m, logits.amax(dim=1))
        l = l * torch.exp(m - m_new) + torch.exp(
            logits - m_new[:, None]).sum(dim=1)
        m = m_new
        hit = logits.masked_fill(cols != lab, float("-inf"))
        ll = torch.maximum(ll, hit.amax(dim=1))
    return m + torch.log(l.clamp_min(1e-30)), ll


def ce_backward_chunked(x, w, labels, valid, lse, g, n_valid: int):
    """(dx in x.dtype, dw in w.dtype) of the mean NLL scaled by ``g``: the
    counterpart of JAX's ``_ce_bwd``.  The logits are rebuilt per 8192-column
    chunk; dlogits = (softmax − onehot)·coef is never whole.  The products
    are fp32, as in JAX, where they run outside any Pallas kernel: they are
    plain large matrix products, left to ``torch.matmul``."""
    T, D = x.shape
    V = w.shape[1]
    vf = valid.float()
    coef = (g * vf / vf.sum().clamp_min(1.0))[:, None]      # (T, 1)
    xf = x.float()
    lab = labels.long()[:, None]
    dx = torch.zeros((T, D), dtype=torch.float32, device=x.device)
    dw = torch.empty((D, V), dtype=w.dtype, device=w.device)
    for c0, c1 in _chunks(V):
        wf = w[:, c0:c1].float()
        cols = torch.arange(c0, c1, device=x.device)[None, :]
        p = torch.exp(xf @ wf - lse[:, None])
        p = p.masked_fill(cols >= n_valid, 0.0)
        dlog = (p - (cols == lab).float()) * coef           # (T, cv)
        dx += dlog @ wf.T
        dw[:, c0:c1] = (xf.T @ dlog).to(w.dtype)
    return dx.to(x.dtype), dw
