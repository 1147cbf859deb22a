"""Launch of the CUDA decode-attention kernel (``csrc/decode_attention.cu``).

Replaces ``src/repro/kernels/decode_attention/kernel.py:decode_attention_pallas``;
the source's header says what bounds the kernel on the H100 and how its
design answers that.  This module checks what the kernel takes, allocates the
output and the split scratch, launches (split pass + merge pass) on
PyTorch's current stream and counts the launch.
"""

from __future__ import annotations

import torch

from ..common import check_status, count_launch, library, stream_ptr

HEAD_DIMS = (64, 128, 192)


def decode_launch_args(q, k, v, lengths, *, scale: float | None,
                       chunk: int) -> tuple:
    """Check the inputs for the kernel and return the C call's scalar
    arguments: (B, Hq, Hkv, S, D, n_split, 8 strides, scale)."""
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("decode attention takes q (B,Hq,D), k/v "
                         "(B,S,Hkv,D)")
    B, Hq, D = q.shape
    Bk, S, Hkv, Dk = k.shape
    if (Bk, Dk) != (B, D):
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"decode kernel needs Hq % Hkv == 0; got {Hq}, "
                         f"{Hkv}")
    if D not in HEAD_DIMS:
        raise ValueError(f"decode kernel takes head dims {HEAD_DIMS}, not {D}")
    if B == 0 or S == 0:
        raise ValueError("decode kernel needs B > 0 and S > 0")
    if lengths.shape != (B,) or lengths.dtype != torch.int32:
        raise ValueError(f"lengths must be ({B},) int32, got "
                         f"{tuple(lengths.shape)} {lengths.dtype}")
    if not lengths.is_contiguous():
        raise ValueError("lengths must be contiguous")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"decode kernel takes bf16, {name} is {t.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs unit stride on the head dim")
        if any(s % 8 for s in t.stride()[:-1]) or t.data_ptr() % 16:
            raise ValueError(f"{name} rows must be 16-byte aligned "
                             f"(strides {t.stride()})")
    n_split = -(-S // chunk)
    scale_v = float(scale if scale is not None else D ** -0.5)
    return (B, Hq, Hkv, S, D, n_split, q.stride(0), q.stride(1),
            *k.stride()[:3], *v.stride()[:3], scale_v)


def decode_attention_cuda(q, k, v, lengths=None, *,
                          scale: float | None = None,
                          return_lse: bool = False):
    """q: (B, Hq, D); k, v: (B, S, Hkv, D); lengths (B,) int32 (None → S);
    bf16 on one CUDA device.  Returns out (B, Hq, D) bf16, and with
    return_lse also m, l (B, Hq) fp32."""
    lib = library()
    if lengths is None:
        lengths = torch.full((q.shape[0],), k.shape[1], dtype=torch.int32,
                             device=q.device)
    args = decode_launch_args(q, k, v, lengths, scale=scale,
                              chunk=lib.decode_attention_chunk())
    B, Hq, Hkv, S, D, n_split = args[:6]
    G = Hq // Hkv
    f32 = dict(dtype=torch.float32, device=q.device)
    part_o = torch.empty((B, Hkv, n_split, G, D), **f32)
    part_m = torch.empty((B, Hkv, n_split, G), **f32)
    part_l = torch.empty((B, Hkv, n_split, G), **f32)
    out = torch.empty((B, Hq, D), dtype=q.dtype, device=q.device)
    m = torch.empty((B, Hq), **f32) if return_lse else None
    l = torch.empty((B, Hq), **f32) if return_lse else None
    status = lib.decode_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), m.data_ptr() if return_lse else None,
        l.data_ptr() if return_lse else None, part_o.data_ptr(),
        part_m.data_ptr(), part_l.data_ptr(), *args, stream_ptr(q.device))
    check_status("decode_attention", status)
    count_launch("decode_attention")
    if return_lse:
        return out, m, l
    return out
