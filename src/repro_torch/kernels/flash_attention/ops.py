"""Public flash-attention wrappers: the plain versions for a CPU tensor, the
CUDA kernels for a CUDA tensor.  Where a gradient is wanted,
``flash_attention`` goes through an ``autograd.Function`` that saves q, k, v,
the output and the row log-sum-exp, and whose backward is
``flash_attention_bwd``."""

from __future__ import annotations

import torch

from ..common import kernel_device
from .kernel import flash_attention_bwd_cuda, flash_attention_cuda
from .ref import attention_bwd_ref, attention_chunked, attention_ref

# from this key length on the plain version runs the online softmax over K
# blocks instead of building the (Sq, Sk) score matrix, as the reference does
CHUNKED_MIN_SEQ = 2048


def _forward(q, k, v, causal, window, scale, return_lse=False):
    if kernel_device(q, k, v) == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    scale=scale, return_lse=return_lse)
    if k.shape[2] >= CHUNKED_MIN_SEQ:
        return attention_chunked(q, k, v, causal=causal, window=window,
                                 scale=scale, return_lse=return_lse)
    return attention_ref(q, k, v, causal=causal, window=window, scale=scale,
                         return_lse=return_lse)


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0, scale: float | None = None):
    """(dq, dk, dv) of flash attention for the upstream gradient ``do``."""
    if kernel_device(q, k, v, o, lse, do) == "cuda":
        return flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=causal,
                                        window=window, scale=scale)
    return attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                             window=window, scale=scale)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        o, lse = _forward(q, k, v, causal, window, scale, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = dict(causal=causal, window=window, scale=scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.to(o.dtype),
                                         **ctx.opts)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float | None = None):
    """Multi-head / grouped-query self-attention.
    q: (B, Hq, S, D); k, v: (B, Hkv, S, D)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, scale)
    return _forward(q, k, v, causal, window, scale)
