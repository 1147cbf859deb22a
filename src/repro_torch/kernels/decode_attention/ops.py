"""Public decode-attention wrapper: the plain version for a CPU tensor, the
CUDA kernel for a CUDA tensor."""

from __future__ import annotations

from ..common import kernel_device
from .kernel import decode_attention_cuda
from .ref import decode_attention_ref


def decode_attention(q, k, v, lengths=None, *, scale: float | None = None,
                     return_lse: bool = False):
    """One-token attention over a (B, S, Hkv, D) KV cache; q: (B, Hq, D).
    With return_lse → (out, m, l) for an LSE merge of partial results."""
    tensors = (q, k, v) if lengths is None else (q, k, v, lengths)
    if kernel_device(*tensors) == "cuda":
        return decode_attention_cuda(q, k, v, lengths, scale=scale,
                                     return_lse=return_lse)
    return decode_attention_ref(q, k, v, lengths, scale=scale,
                                return_lse=return_lse)
