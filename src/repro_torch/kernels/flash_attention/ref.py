"""Plain PyTorch attention (the counterparts of
``repro.kernels.flash_attention.ref``): GQA, causal, optional local window.

* :func:`attention_ref` builds the full (Sq, Sk) score matrix in fp32;
* :func:`attention_chunked` runs an online softmax over K blocks, so its
  live memory is O(Sq·block) (the wrapper takes it at Sk >= 2048);
* :func:`attention_bwd_ref` is the gradient of :func:`attention_ref`."""

from __future__ import annotations

import torch


def _mask(Sq: int, Sk: int, causal: bool, window: int, device):
    """(Sq, Sk) bool: which keys each query sees.  Queries occupy the last
    Sq positions of the Sk context."""
    q_pos = torch.arange(Sq, device=device)[:, None] + (Sk - Sq)
    k_pos = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    return mask


def _scores(q, k, causal, window, scale):
    """fp32 scores (B, Hq, Sq, Sk), masked with -inf, and the GQA group."""
    Hq, Hkv = q.shape[1], k.shape[1]
    if Hq % Hkv:
        raise ValueError(f"GQA needs Hq % Hkv == 0, got {Hq} and {Hkv}")
    group = Hq // Hkv
    kq = k.repeat_interleave(group, dim=1)           # (B, Hq, Sk, D)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), kq.float()) * scale
    mask = _mask(q.shape[2], k.shape[2], causal, window, q.device)
    return scores.masked_fill(~mask, float("-inf")), group


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  scale: float | None = None, return_lse: bool = False):
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D); GQA via Hq % Hkv == 0.
    window > 0 → local attention of that width.  Queries occupy the last Sq
    positions of the Sk context.  Returns (B, Hq, Sq, D) in q.dtype, and
    with ``return_lse`` also the row log-sum-exp of the scaled scores,
    (B, Hq, Sq) fp32."""
    D = q.shape[-1]
    scale = scale if scale is not None else D ** -0.5
    scores, group = _scores(q, k, causal, window, scale)
    vq = v.repeat_interleave(group, dim=1)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    s = p.sum(dim=-1, keepdim=True)
    p = p / s
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype), vq).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(s))[..., 0]
    return out


def attention_chunked(q, k, v, *, causal: bool = True, window: int = 0,
                      scale: float | None = None, block_k: int = 1024,
                      return_lse: bool = False):
    """Flash-style online softmax over K blocks of ``block_k`` keys (shapes
    as :func:`attention_ref`); masked scores are -1e30, so a row that sees
    no key gives 0.  With ``return_lse`` also the row log-sum-exp of the
    scaled scores, (B, Hq, Sq) fp32."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"GQA needs Hq % Hkv == 0, got {Hq} and {Hkv}")
    group = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    bk = min(block_k, Sk)
    qf = q.float() * scale
    q_pos = torch.arange(Sq, device=q.device) + (Sk - Sq)
    m = torch.full((B, Hq, Sq), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Hq, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hq, Sq, D), dtype=torch.float32, device=q.device)
    for start in range(0, Sk, bk):
        kt = k[:, :, start:start + bk].repeat_interleave(group, dim=1).float()
        vt = v[:, :, start:start + bk].repeat_interleave(group, dim=1).float()
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kt)
        k_pos = torch.arange(start, start + kt.shape[2], device=q.device)
        mask = torch.ones((Sq, kt.shape[2]), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= k_pos[None, :] <= q_pos[:, None]
        if window > 0:
            mask &= k_pos[None, :] > q_pos[:, None] - window
        s = s.masked_fill(~mask, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vt)
        m = m_new
    out = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    if return_lse:
        return out, m + torch.log(l)
    return out


def attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                      window: int = 0, scale: float | None = None):
    """The gradient of :func:`attention_ref` for the upstream ``do``:
    (dq, dk, dv) in the dtypes of q, k, v.

    P = exp(S·scale − lse) is rebuilt from the saved lse;
    dV = Pᵀ·dO, dP = dO·Vᵀ, Δ = rowsum(dO∘O), dS = P∘(dP − Δ),
    dQ = scale·dS·K, dK = scale·dSᵀ·Q; dK and dV sum over the q heads of a
    kv head's group.  P and dS are rounded to q's dtype before their
    products, as the kernel rounds them to bf16 for the tensor cores (a
    no-op in fp32)."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    scores, group = _scores(q, k, causal, window, scale)
    kq = k.repeat_interleave(group, dim=1).float()
    vq = v.repeat_interleave(group, dim=1).float()
    p = torch.exp(scores - lse[..., None].float())   # masked → 0
    dof = do.float()
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(q.dtype).float(), dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vq)
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta)).to(q.dtype).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kq) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    dk = dk.reshape(B, Hkv, group, Sk, D).sum(dim=2)
    dv = dv.reshape(B, Hkv, group, Sk, D).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
