"""Public flash-attention wrapper: the plain version for a CPU tensor, the
CUDA kernel for a CUDA tensor."""

from __future__ import annotations

from ..common import kernel_device
from .kernel import flash_attention_cuda
from .ref import attention_ref


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float | None = None):
    """Multi-head / grouped-query self-attention.
    q: (B, Hq, S, D); k, v: (B, Hkv, S, D)."""
    if kernel_device(q, k, v) == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    scale=scale)
    return attention_ref(q, k, v, causal=causal, window=window, scale=scale)
