"""Launch of the CUDA flash-attention kernel (``csrc/flash_attention.cu``).

Replaces ``src/repro/kernels/flash_attention/kernel.py:flash_attention_pallas``;
the source's header says what bounds the kernel on the H100 and how its
design answers that.  This module checks what the kernel takes, allocates the
output, launches on PyTorch's current stream and counts the launch.
"""

from __future__ import annotations

import torch

from ..common import check_status, count_launch, library, stream_ptr

HEAD_DIMS = (128,)


def flash_launch_args(q, k, v, out, *, causal: bool, window: int,
                      scale: float | None) -> tuple:
    """Check q/k/v/out for the kernel and return the C call's scalar
    arguments: (B, Hq, Hkv, S, D, 12 strides, scale, causal, window)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes q (B,Hq,S,D), k/v "
                         "(B,Hkv,S,D)")
    B, Hq, S, D = q.shape
    Bk, Hkv, Sk, Dk = k.shape
    if (Bk, Sk, Dk) != (B, S, D) or v.shape != k.shape:
        raise ValueError(f"self-attention shapes disagree: q {tuple(q.shape)}"
                         f", k {tuple(k.shape)}, v {tuple(v.shape)}")
    if out.shape != q.shape:
        raise ValueError("output shape must equal q's")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"GQA needs Hq % Hkv == 0, got {Hq} and {Hkv}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash kernel takes head dims {HEAD_DIMS}, not {D}")
    if B == 0 or S == 0:
        raise ValueError("flash kernel needs B > 0 and S > 0")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash kernel takes bf16, {name} is {t.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs unit stride on the head dim")
        # cp.async / 4-byte stores need 16-byte aligned rows
        if any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name} rows must be 16-byte aligned "
                             f"(strides {t.stride()})")
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *out.stride()[:3])
    scale_v = float(scale if scale is not None else D ** -0.5)
    return (B, Hq, Hkv, S, D, *strides, scale_v, int(causal), int(window))


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         scale: float | None = None) -> torch.Tensor:
    """q: (B, Hq, S, D); k, v: (B, Hkv, S, D); bf16 on one CUDA device, any
    (batch, head, seq) strides with a unit head-dim stride.  The output has
    q's shape and, where q is dense, q's strides: for q viewed from a
    (B, S, Hq, D) tensor, out.transpose(1, 2) is contiguous."""
    out = torch.empty_like(q)
    args = flash_launch_args(q, k, v, out, causal=causal, window=window,
                             scale=scale)
    status = library().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *args,
        stream_ptr(q.device))
    check_status("flash_attention", status)
    count_launch("flash_attention")
    return out
