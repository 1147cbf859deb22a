"""Launch of the CUDA flash-attention kernels: the forward
(``csrc/flash_attention.cu``) and its backward (``csrc/flash_attention_bwd.cu``).

The forward replaces
``src/repro/kernels/flash_attention/kernel.py:flash_attention_pallas``; the
backward has no Pallas counterpart (the JAX package cannot differentiate
through that kernel) and computes the gradient of its ``attention_ref``.
The sources' headers say what bounds each kernel on the H100 and how its
design answers that.  This module checks what the kernels take, allocates
outputs and scratch, launches on PyTorch's current stream and counts each
launch.
"""

from __future__ import annotations

import torch

from ..common import check_status, count_launch, library, stream_ptr

HEAD_DIMS = (64, 128, 192)
# The backward is built at the head dims of the configs that train on one
# card: 128 (qwen2-7b) and 64 (granite-moe-3b-a800m).  192 (nemotron-4-340b)
# is queued in ROADMAP.md.
BWD_HEAD_DIMS = (64, 128)


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
                         scale: float | None = None,
                         return_lse: bool = False):
    """q: (B, Hq, S, D); k, v: (B, Hkv, S, D); bf16 on one CUDA device, any
    (batch, head, seq) strides with a unit head-dim stride.  The output has
    q's shape and, where q is dense, q's strides: for q viewed from a
    (B, S, Hq, D) tensor, out.transpose(1, 2) is contiguous.  With
    ``return_lse`` also the row log-sum-exp (B, Hq, S) fp32."""
    out = torch.empty_like(q)
    args = flash_launch_args(q, k, v, out, causal=causal, window=window,
                             scale=scale)
    lse = (torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
           if return_lse else None)
    status = library().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *args,
        lse.data_ptr() if return_lse else None, stream_ptr(q.device))
    check_status("flash_attention", status)
    count_launch("flash_attention")
    return (out, lse) if return_lse else out


def _strided_ok(t: torch.Tensor) -> torch.Tensor:
    """``t`` if the kernel can read it through its strides (unit head-dim
    stride, 16-byte aligned rows), else a contiguous copy.  The upstream
    gradient of the model's ``o.transpose(1, 2).reshape(...)`` arrives as a
    strided view and is read as it is."""
    if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) \
            or t.data_ptr() % 16:
        return t.contiguous()
    return t


def flash_bwd_launch_args(q, k, v, o, lse, do, dq, dk, dv, *,
                          causal: bool, window: int,
                          scale: float | None) -> tuple:
    """Check the backward's inputs and its outputs dq, dk, dv for the kernel
    and return the C call's scalar arguments: (B, Hq, Hkv, S, D, 24
    strides, scale, causal, window)."""
    if q.shape[-1] not in BWD_HEAD_DIMS:
        raise ValueError(f"flash backward kernel takes head dims "
                         f"{BWD_HEAD_DIMS}, not {q.shape[-1]}")
    args = flash_launch_args(q, k, v, o, causal=causal, window=window,
                             scale=scale)
    # do must suit the kernel as the output does (shape, bf16, strides)
    flash_launch_args(q, k, v, do, causal=causal, window=window, scale=scale)
    B, Hq, S = q.shape[:3]
    if lse.shape != (B, Hq, S) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous ({B}, {Hq}, {S}) fp32, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    for name, t, like in (("dq", dq, q), ("dk", dk, k), ("dv", dv, v)):
        if t.shape != like.shape or t.dtype != like.dtype:
            raise ValueError(f"{name} must have the shape and dtype of its "
                             "input")
        if any(s % 8 for s in t.stride()[:3]) or t.stride(-1) != 1:
            raise ValueError(f"{name} strides {t.stride()} do not suit the "
                             "kernel")
    strides = (*args[5:14], *args[14:17])        # q, k, v, o
    strides += (*do.stride()[:3], *dq.stride()[:3], *dk.stride()[:3],
                *dv.stride()[:3])
    return (*args[:5], *strides, *args[17:])


def flash_bwd_scratch_shape(q, rows: int) -> tuple:
    """The backward's fp32 scratch: a (lse·log2e, Delta) pair for each
    (batch, q head, row), the rows padded to a multiple of ``rows`` (the
    kernel's ``flash_attention_bwd_rows()``)."""
    B, Hq, S = q.shape[:3]
    return (B, Hq, -(-S // rows) * rows, 2)


def flash_attention_bwd_cuda(q, k, v, o, lse, do, *, causal: bool = True,
                             window: int = 0, scale: float | None = None):
    """The gradient of flash attention: (dq, dk, dv), each with the shape,
    dtype and (where dense) strides of q, k, v.  ``o`` and ``lse`` are the
    forward's output and row log-sum-exp; ``do`` the upstream gradient."""
    do = _strided_ok(do)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    args = flash_bwd_launch_args(q, k, v, o, lse, do, dq, dk, dv,
                                 causal=causal, window=window, scale=scale)
    lib = library()
    shape = flash_bwd_scratch_shape(q, lib.flash_attention_bwd_rows())
    rows = torch.empty(shape, dtype=torch.float32, device=q.device)
    status = lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), rows.data_ptr(), *args, stream_ptr(q.device))
    check_status("flash_attention_bwd", status)
    count_launch("flash_attention_bwd")
    return dq, dk, dv
