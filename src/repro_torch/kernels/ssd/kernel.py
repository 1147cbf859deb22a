"""Launch of the CUDA chunked SSD-scan kernel (``csrc/ssd_scan.cu``).

Replaces ``src/repro/kernels/ssd/kernel.py:ssd_scan_pallas``; the source's
header says what bounds the kernel on the H100 and how its design answers
that.  This module checks what the kernel takes, allocates y and s_final,
launches on PyTorch's current stream and counts the launch.

The JAX wrapper pads S to a multiple of the chunk with zeros; the kernel
masks the ragged last chunk itself (rows past S act as log_a = 0, gate = 0),
so no padded copy is made.
"""

from __future__ import annotations

import torch

from ..common import check_status, count_launch, library, stream_ptr

# (N, P) pairs the kernel is built for: zamba2's state 64 and head dim 64.
SHAPES = ((64, 64),)


def ssd_launch_args(c, b, x, log_a, gate, y) -> tuple:
    """Check the inputs and the output y for the kernel and return the C
    call's scalar arguments: (B, H, S, N, P, 18 strides) with the
    (batch, head, seq) strides of c, b, x, y, log_a and gate."""
    if c.dim() != 4 or b.shape != c.shape or x.dim() != 4:
        raise ValueError("ssd scan takes c, b (B,H,S,N) and x (B,H,S,P)")
    B, H, S, N = c.shape
    P = x.shape[-1]
    if x.shape[:3] != (B, H, S) or y.shape != x.shape:
        raise ValueError(f"shapes disagree: c {tuple(c.shape)}, x "
                         f"{tuple(x.shape)}, y {tuple(y.shape)}")
    if log_a.shape != (B, H, S) or gate.shape != (B, H, S):
        raise ValueError(f"log_a and gate must be ({B}, {H}, {S}), got "
                         f"{tuple(log_a.shape)} and {tuple(gate.shape)}")
    if (N, P) not in SHAPES:
        raise ValueError(
            f"ssd kernel takes (N, P) in {SHAPES}, not ({N}, {P}); the "
            "kernel tiled over N and P that xlstm's (512, 513) needs is "
            "queued in ROADMAP.md")
    if B == 0 or H == 0 or S == 0:
        raise ValueError("ssd kernel needs B, H and S > 0")
    for name, t in (("c", c), ("b", b), ("x", x), ("y", y)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"ssd kernel takes bf16 c, b, x; {name} is "
                            f"{t.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs unit stride on its last dim")
        # cp.async / 4-byte stores need 16-byte aligned rows; a head stride
        # of 0 (b and c shared by all heads) is allowed
        if any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name} rows must be 16-byte aligned "
                             f"(strides {t.stride()})")
    for name, t in (("log_a", log_a), ("gate", gate)):
        if t.dtype != torch.float32:
            raise TypeError(f"ssd kernel takes fp32 {name}, got {t.dtype}")
    strides = (*c.stride()[:3], *b.stride()[:3], *x.stride()[:3],
               *y.stride()[:3], *log_a.stride(), *gate.stride())
    return (B, H, S, N, P, *strides)


def ssd_scan_cuda(c, b, x, log_a, gate):
    """c, b: (B, H, S, N) bf16; x: (B, H, S, P) bf16; log_a, gate: (B, H, S)
    fp32; all on one CUDA device, read through their strides (b and c may
    have a head stride of 0).  Returns y (B, H, S, P) bf16, with x's strides
    where x is dense, and s_final (B, H, N, P) fp32."""
    y = torch.empty_like(x)
    args = ssd_launch_args(c, b, x, log_a, gate, y)
    B, H, _, N, P = args[:5]
    s_final = torch.empty((B, H, N, P), dtype=torch.float32, device=x.device)
    status = library().ssd_scan_fwd(
        c.data_ptr(), b.data_ptr(), x.data_ptr(), log_a.data_ptr(),
        gate.data_ptr(), y.data_ptr(), s_final.data_ptr(), *args,
        stream_ptr(x.device))
    check_status("ssd_scan", status)
    count_launch("ssd_scan")
    return y, s_final
